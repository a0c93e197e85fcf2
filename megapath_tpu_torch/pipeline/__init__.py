"""The MegaPath pipeline on the port's engines (port of ``megapath_tpu.pipeline``)."""

from megapath_tpu_torch.pipeline.megapath import (  # noqa: F401
    MegaPathPipeline,
    PipelineConfig,
    PipelineResult,
)
