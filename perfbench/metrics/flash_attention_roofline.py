"""``flash_attention``'s forward kernels (``kernels/flash_attention``: the
wgmma, the CUDA-core and the panel kernel) as a share of their roofline:
the least time the card could take for the calls the profiled part made,
over the kernels' device time.

The work of a call is counted from its shapes, whatever implements it:
the causal half of the two products, 4 B H S^2 Dh / 2 operations, at the
dtype's tensor-core peak (bfloat16 and float16 989 TFLOP/s, float32
outside the tensor cores 67); q, k and v read once and the output written
once, B S (2 H + 2 K) Dh bytes of the element size, at the HBM rate.
NVIDIA's data sheet, H100 SXM 80 GB at 700 W."""

HBM_BYTES_PER_S = 3.35e12
PEAK = {2: 989e12, 4: 67e12}
KERNELS = r"\bflash_attention_(wgmma|kernel|panels)\b"


def call_flops(batch: int, seq: int, heads: int, head_dim: int, causal: bool) -> float:
    full = 4.0 * batch * heads * seq * seq * head_dim
    return full / 2 if causal else full


def call_bytes(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int, elem: int) -> int:
    return batch * seq * (2 * heads + 2 * kv_heads) * head_dim * elem


def bound_s(call: dict) -> float:
    return max(call_flops(call["batch"], call["seq"], call["heads"], call["head_dim"],
                          call["causal"]) / PEAK[call["elem"]],
               call_bytes(call["batch"], call["seq"], call["heads"], call["kv_heads"],
                          call["head_dim"], call["elem"]) / HBM_BYTES_PER_S)


def read(ctx: dict):
    calls, p = ctx["work"].get("flash_attention"), ctx["profile"]
    seconds, launches = p["trace"].kernel_time(KERNELS)
    if not calls or not launches:
        return None
    ctx.get("log", print)(f"[trace] flash_attention_roofline: {launches} launches, "
                          f"{seconds:.6f} s in {p['units']} units of {len(calls)} calls")
    return 100.0 * p["units"] * sum(bound_s(c) for c in calls) / seconds
