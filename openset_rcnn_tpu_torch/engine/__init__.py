"""Training (the optimizer and learning-rate schedule, and the train step)
and evaluation orchestration (``train_loop.do_test``)."""
