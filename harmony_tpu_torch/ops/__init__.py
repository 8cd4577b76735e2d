"""Hand-written Hopper kernels and their plain PyTorch versions, and the ops
built on them (counterpart of ``harmony_tpu.ops``)."""
from harmony_tpu_torch.ops.attention import blockwise_attention, flash_attention
from harmony_tpu_torch.ops.histogram import segment_sum, weighted_histogram
from harmony_tpu_torch.ops.mxu import mxu_dot
from harmony_tpu_torch.ops.ring import ring_attention
from harmony_tpu_torch.ops.sparse import gather_rows, segment_sum_rows
from harmony_tpu_torch.ops.ulysses import a2a_attention, a2a_self_attention

__all__ = [
    "a2a_attention",
    "a2a_self_attention",
    "blockwise_attention",
    "flash_attention",
    "gather_rows",
    "mxu_dot",
    "ring_attention",
    "segment_sum",
    "segment_sum_rows",
    "weighted_histogram",
]
