from ranklib_tpu_torch.data.letor import read_letor, write_letor  # noqa: F401
