"""The operation and byte counts against hand counts at small shapes."""

from benchmark import flops, peaks


def test_forward_of_a_small_actor_critic():
    # obs 3 -> trunk (4, 2) -> 5 actions; critic 3 -> (4, 2) -> 1, over 10 rows
    got = flops.actor_critic_forward(3, 5, (4, 2), (4, 2), 10)
    trunk = 2 * 10 * (3 * 4 + 4 * 2) * 2
    heads = 2 * 10 * (2 * 5 + 2 * 1)
    assert got == {"bf16": trunk, "f32": heads}


def test_train_step_skips_the_first_input_gradient():
    got = flops.actor_critic_train_step(3, 5, (4, 2), (4, 2), 10)
    # first layer: forward + weight gradient; second: also the input's
    trunk = 2 * (2 * 10 * 3 * 4 * 2 + 2 * 10 * 4 * 2 * 3)
    heads = 3 * 2 * 10 * (2 * 5 + 2)
    assert got == {"bf16": trunk, "f32": heads}


def test_epoch_adds_rollout_and_update():
    got = flops.actor_critic_epoch(3, 5, (4, 2), (4, 2), envs=8, horizon=4, mini_epochs=2,
                                   minibatch=16)
    fwd = flops.actor_critic_forward(3, 5, (4, 2), (4, 2), 8)
    step = flops.actor_critic_train_step(3, 5, (4, 2), (4, 2), 16)
    steps = 2 * (8 * 4 // 16)
    for k in ("bf16", "f32"):
        assert got[k] == fwd[k] * 5 + step[k] * steps


def test_moe_linear_counts():
    got = flops.moe_linear(batch=2, layers=((3, 4),), experts=5)
    assert got["ops"] == 2 * 5 * 2 * 3 * 4
    assert got["bytes"] == 4 * (2 * 3 + 2 * 5 + 5 * 3 * 4 + 5 * 4 + 2 * 4)


def test_fk_bytes_at_the_stage_one_size():
    # 23.7 MB at 10,240 envs and 24 joints, the figure the port's notes use
    assert abs(flops.fk_chain_bytes(10240, 24) - 23.72e6) < 0.01e6


def test_least_seconds():
    assert peaks.least_seconds({"bf16": 989e12, "f32": 67e12}) == 2.0
