"""The paper's comparison baselines (§VI, Fig. 9); PyTorch port of
``repro.baselines``.  Each baseline runs its detector on its ``device``
(``"cuda"`` by default) and returns host numpy results, as in JAX."""
from repro_torch.baselines.common import BaselineResult  # noqa: F401
from repro_torch.baselines.mpeg import MPEGBaseline  # noqa: F401
from repro_torch.baselines.glimpse import GlimpseBaseline  # noqa: F401
from repro_torch.baselines.cloudseg import CloudSegBaseline  # noqa: F401
from repro_torch.baselines.dds import DDSBaseline  # noqa: F401
