"""Host-side data pipeline of the port: the JAX package's ``data/``
modules (numpy and scipy only), copied so that the port imports nothing
of that package."""

from sepreformer_torch.data.audio import read_wav, write_wav  # noqa: F401
from sepreformer_torch.data.dataset import (  # noqa: F401
    SeparationDataset,
    build_dataloaders,
)
from sepreformer_torch.data.scp import parse_scps  # noqa: F401
from sepreformer_torch.data.synth import generate_corpus  # noqa: F401
