from linearham_tpu_torch.models.decode import Annotation
from linearham_tpu_torch.models.simple_hmm import SimpleHMM

__all__ = ["Annotation", "SimpleHMM"]
