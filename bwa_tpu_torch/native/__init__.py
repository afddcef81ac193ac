from bwa_tpu_torch.native.build import get_lib  # noqa: F401
