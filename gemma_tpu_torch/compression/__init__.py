from gemma_tpu_torch.compression.registry import (  # noqa: F401
    Type,
    TYPE_NAMES,
    TYPE_BITS,
    PackedTensor,
    compress,
    compress_tensor,
    decompress,
    packed_nbytes,
    type_from_name,
)
