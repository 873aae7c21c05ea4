"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time of a call: the
larger of its operations over the peak and its bytes over the memory
bandwidth."""

PEAK_FLOPS = {
    "f32": 67e12,  # CUDA cores, outside the tensor cores
    "tf32": 495e12,
    "bf16": 989e12,
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, bytes_moved: float,
                  precision: str = "f32") -> float:
    return max(flops / PEAK_FLOPS[precision], bytes_moved / HBM_BYTES_PER_S)
