"""Shape table of the LM family (a copy of ``repro/configs/_shapes.py``'s
``LM_SHAPES``; the other families' tables come with their slices)."""
from ..config import ShapeSpec

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          (("seq_len", 4096), ("global_batch", 256))),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             (("seq_len", 32768), ("global_batch", 32))),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            (("seq_len", 32768), ("global_batch", 128))),
    "long_500k": ShapeSpec("long_500k", "decode",
                           (("seq_len", 524288), ("global_batch", 1))),
}
