"""Training runtime: the step factory (``train_loop``) and fault
tolerance (``fault``)."""
