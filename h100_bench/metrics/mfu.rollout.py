"""The model's useful products over the untraced window's wall, as a share
of the TF32 tensor-core peak (495 TFLOP/s), in percent."""

from h100_bench.readers import mfu_percent


def read(record, window, cfg):
    return mfu_percent(window)
