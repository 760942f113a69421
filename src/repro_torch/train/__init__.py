"""Training: the train step (``train_loop``)."""
