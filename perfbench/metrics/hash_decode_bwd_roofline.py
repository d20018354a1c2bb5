"""``hash_decode``'s codebook gradient (``kernels/hash_decode``: the
count, place and sum kernels of one call) as a share of its roofline.

The work of a call is counted from its shapes: the (rows, d_c) float32
cotangent and the (rows, m) int32 codes read once, the (m, c, d_c)
gradient written once; rows m d_c float32 adds.  The bound is the larger
of bytes over the HBM rate and adds over the f32 add rate (NVIDIA's data
sheet, H100 SXM 80 GB at 700 W)."""

HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 67e12 / 2
KERNELS = r"\bhash_decode_(count|place|sum)_kernel\b"


def call_bytes(rows: int, m: int, c: int, d_c: int, elem: int) -> int:
    return rows * d_c * 4 + rows * m * 4 + m * c * d_c * elem


def call_adds(rows: int, m: int, d_c: int) -> int:
    return rows * m * d_c


def bound_s(call: dict) -> float:
    return max(call_bytes(call["rows"], call["m"], call["c"], call["d_c"], call["elem"])
               / HBM_BYTES_PER_S,
               call_adds(call["rows"], call["m"], call["d_c"]) / F32_ADDS_PER_S)


def read(ctx: dict):
    calls, p = ctx["work"].get("hash_decode_bwd"), ctx["profile"]
    seconds, launches = p["trace"].kernel_time(KERNELS)
    if not calls or not launches:
        return None
    ctx.get("log", print)(f"[trace] hash_decode_bwd_roofline: {launches} launches, "
                          f"{seconds:.6f} s in {p['units']} units of {len(calls)} calls")
    return 100.0 * p["units"] * sum(bound_s(c) for c in calls) / seconds
