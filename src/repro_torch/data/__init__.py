from repro_torch.data.synthetic_covtype import make_covtype_like  # noqa: F401
