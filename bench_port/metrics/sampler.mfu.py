"""The window's denoiser and encoder FLOPs (`flops.py`, from shapes) over
its wall time and the H100's published float32 peak, in percent."""

from bench_port.harness import F32_FLOP_PER_S


def read(rec):
    if not rec.get("flops") or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / F32_FLOP_PER_S
