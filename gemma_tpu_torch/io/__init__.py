from gemma_tpu_torch.io.blob_store import BlobReader, BlobWriter  # noqa: F401
from gemma_tpu_torch.io.fields import Fields, read_fields, write_fields  # noqa: F401
