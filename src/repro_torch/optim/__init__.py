"""repro_torch.optim -- AdamW and int8 gradient compression (a port of
``repro/optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update, cosine_schedule
from .compress import (compress_int8, decompress_int8, ef_compressed_psum,
                       ef_compressed_psum_axis)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_int8", "decompress_int8", "ef_compressed_psum",
           "ef_compressed_psum_axis"]
