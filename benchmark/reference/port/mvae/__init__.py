"""The MotionVAE network (`model`)."""
