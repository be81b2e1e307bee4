"""Command line of the port (counterpart of ``vid2player3d_tpu/cli``).

    python -m vid2player3d_torch --cfg amass_im                    # low-level stage 1
    python -m vid2player3d_torch --cfg federer_im                  # stage-2 fine-tune
    python -m vid2player3d_torch --cfg federer_train_stage_1       # high-level stage 1
    python -m vid2player3d_torch --cfg federer --test --render r.html   # evaluation
    python -m vid2player3d_torch --cfg mvae_federer                # MotionVAE training

Each runs on the card; `--device cpu` runs it on the CPU.
"""

from vid2player3d_torch.cli.configs import CONFIGS, RunConfig, get_config
from vid2player3d_torch.cli.run import main

__all__ = ["CONFIGS", "RunConfig", "get_config", "main"]
