from mysteryann_tpu_torch.io.synthetic import make_cross_modal  # noqa: F401
