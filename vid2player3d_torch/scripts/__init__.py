"""The system's own scripts on the port (counterparts of the repo's ``scripts/``).

Each runs as ``python -m vid2player3d_torch.scripts.<name>`` with the JAX
script's arguments plus ``--device``, on the card unless asked for
``--device cpu`` (with no card and no ``--device`` it raises):

- ``probe_e2e_im``: the AMASS-format fixture writer and the learning-rate
  probe behind the curriculum's imitation recipe;
- ``e2e_curriculum``: the full curriculum end to end through the command
  line (fixture → AMASS conversion → federer_im → mvae_federer --pre_run →
  federer_train_stage_1 → --test --render), with its learning checks;
- ``swing_quality``: the synthetic swing rig's go/no-go (the env's
  stringbed contact at each annotated contact, the ball flown on);
- ``local_sgd_convergence``: per-minibatch against per-mini-epoch
  (local SGD) data parallelism over 4 ranks.
"""
