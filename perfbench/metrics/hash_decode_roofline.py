"""``hash_decode``'s forward kernels (``kernels/hash_decode``: the staged
and the direct variant) as a share of their roofline: the least time the
card could take for the calls the profiled part made, over the kernels'
device time.

The work of a call is counted from its shapes, whatever implements it:
the (rows, m) int32 codes read once, each codebook row that the codes
name read once, the (rows, d_c) float32 rows written once; rows (m - 1)
d_c float32 adds.  The bound is the larger of bytes over the HBM rate and
adds over the f32 add rate (an add runs at the FMA rate, half the data
sheet's 67 TFLOP/s, which counts an FMA as two operations).  NVIDIA's
data sheet, H100 SXM 80 GB at 700 W."""

HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 67e12 / 2
KERNELS = r"\bhash_decode_(staged|kernel)\b"


def call_bytes(rows: int, m: int, c: int, d_c: int, elem: int, named: int) -> int:
    return rows * m * 4 + named * d_c * elem + rows * d_c * 4


def call_adds(rows: int, m: int, d_c: int) -> int:
    return rows * (m - 1) * d_c


def bound_s(call: dict) -> float:
    return max(call_bytes(call["rows"], call["m"], call["c"], call["d_c"], call["elem"],
                          call["named"]) / HBM_BYTES_PER_S,
               call_adds(call["rows"], call["m"], call["d_c"]) / F32_ADDS_PER_S)


def read(ctx: dict):
    calls, p = ctx["work"].get("hash_decode"), ctx["profile"]
    seconds, launches = p["trace"].kernel_time(KERNELS)
    if not calls or not launches:
        return None
    ctx.get("log", print)(f"[trace] hash_decode_roofline: {launches} launches, {seconds:.6f} s in "
                          f"{p['units']} units of {len(calls)} calls")
    return 100.0 * p["units"] * sum(bound_s(c) for c in calls) / seconds
