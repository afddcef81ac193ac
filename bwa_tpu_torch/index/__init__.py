from bwa_tpu_torch.index.pack import fasta2bnt, Bnt, Contig  # noqa: F401
from bwa_tpu_torch.index.build import index_build  # noqa: F401
from bwa_tpu_torch.index.fmindex import FMIndex  # noqa: F401
