"""What the harness knows of each kind of configuration (`"kind"` in its file):
how to build the port's learner through its command line, the weights the
benchmark draws from the seed, and the frozen reference's learner."""
