from repro_torch.train.train_step import make_train_step  # noqa: F401
