"""The plain reference (`port/`, a frozen copy of the port's plain code), the
control's lower precision (`precision.py`) and the reference's training
epochs (`train.py`). Nothing here imports the port, JAX or the JAX package."""
