"""The bits of the port's kernels at the shapes its model paths give them, so
that two checkouts can be held to the same outputs.

    PYTHONPATH=<checkout A>/src python src/repro_torch/kernels/bits.py save a.json
    PYTHONPATH=<checkout B>/src python src/repro_torch/kernels/bits.py save b.json
    python src/repro_torch/kernels/bits.py compare a.json b.json

Run by its path, the file drives the kernels of whichever package
PYTHONPATH names (it uses only entry points that every checkout since the
f32 flash redesign has).  ``save`` runs each case on the card from inputs
drawn with numpy from a fixed seed and writes each output's shape, dtype and
SHA-256 of its bytes; ``compare`` prints, case by case, whether the two
files' outputs are the same bits, and exits 1 if any differs.
"""

from __future__ import annotations

import hashlib
import json
import sys

# (B, H, K, S, D, causal, dtype): every shape a model path gives flash, and
# a GQA and a ragged one; all contiguous and 16-byte aligned
FLASH = [(4, 16, 16, 2048, 64, True, "bfloat16"), (4, 16, 16, 2048, 64, True, "float32"),
         (4, 32, 32, 2048, 112, True, "bfloat16"), (4, 32, 32, 2048, 112, True, "float32"),
         (2, 8, 2, 2048, 128, True, "float32"), (2, 8, 2, 1000, 128, True, "bfloat16"),
         (2, 4, 4, 1000, 80, False, "float32"), (4, 4, 4, 256, 32, True, "float32"),
         (4, 4, 4, 128, 32, True, "float32"), (1, 4, 2, 257, 64, True, "bfloat16")]
# (B, m, c, d_c, storage): the decode step's 8 rows, the reconstruction's
# 512, a w0 path, the int8 path's largest frontier, the training's 8,192
# bf16 rows, one request's 61,696 and the full graph's 169,343
DECODE = [(8, 16, 256, 512, "float32"), (512, 16, 256, 512, "float32"),
          (4096, 16, 256, 512, "float32+w0"), (24_832, 16, 256, 512, "int8"),
          (8192, 16, 256, 512, "bfloat16"), (61_696, 16, 256, 512, "float32"),
          (169_343, 16, 256, 512, "float32")]
# (B, m, c, d_c, gradient dtype, w0): the codebook gradient
BACKWARD = [(512, 16, 256, 512, "float32", False), (8192, 16, 256, 512, "bfloat16", False),
            (24_064, 16, 256, 512, "float32", False), (61_696, 16, 256, 512, "float32", True),
            (169_343, 16, 256, 512, "float32", False), (61_696, 3, 16, 130, "bfloat16", True)]
# (n, d, w): the reconstruction's and the vocabulary's projections
LSH = [(200_000, 300, 128), (152_064, 512, 128)]


def digest(t) -> dict:
    import torch
    t = t.detach().contiguous().cpu()
    raw = t.view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8)
    return dict(shape=list(t.shape), dtype=str(t.dtype),
                sha256=hashlib.sha256(raw.numpy().tobytes()).hexdigest())


def save(path: str) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.hash_decode import ops as hd
    from repro_torch.kernels.lsh_encode import ops as lsh
    if not torch.cuda.is_available():
        sys.exit("bits: needs a CUDA card")
    out = {}

    def draw(rng, shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()

    for i, (B, H, K, S, D, causal, dtype) in enumerate(FLASH):
        rng = np.random.default_rng(i)
        q, k, v = (draw(rng, (B, S, n, D)).to(getattr(torch, dtype)) for n in (H, K, K))
        out[f"flash {B}x{H}x{K}x{S}x{D} causal={causal} {dtype}"] = digest(
            fa.flash_attention(q, k, v, causal=causal))
    for i, (B, m, c, d_c, storage) in enumerate(DECODE):
        rng = np.random.default_rng(100 + i)
        codes = torch.from_numpy(rng.integers(0, c, (B, m)).astype(np.int32)).cuda()
        cb, w0, scales = draw(rng, (m, c, d_c)), draw(rng, (d_c,)), None
        kind, _, with_w0 = storage.partition("+")
        if kind == "bfloat16":
            cb = cb.to(torch.bfloat16)
        elif kind == "int8":
            cb, scales = hd.quantize_codebooks(cb)
        w0 = w0 if with_w0 else None
        name = f"hash_decode {B}x{m}x{c}x{d_c} {storage}"
        out[name] = digest(hd.hash_decode(codes, cb, w0, scales))
        for variant in ("direct", "staged"):
            out[f"{name} {variant}"] = digest(hd._forward(codes, cb, w0, scales, variant))
    for i, (B, m, c, d_c, dtype, with_w0) in enumerate(BACKWARD):
        rng = np.random.default_rng(200 + i)
        codes = torch.from_numpy(rng.integers(0, c, (B, m)).astype(np.int32)).cuda()
        g, w0 = draw(rng, (B, d_c)), draw(rng, (d_c,))
        name = f"hash_decode_backward {B}x{m}x{c}x{d_c} {dtype}{'+w0' if with_w0 else ''}"
        offsets, rows = hd.code_order(codes, c)
        out[f"{name} offsets"], out[f"{name} rows"] = digest(offsets), digest(rows)
        out[name] = digest(hd.codebook_grad(codes, g, w0 if with_w0 else None, c,
                                            getattr(torch, dtype)))
    for i, (n, d, w) in enumerate(LSH):
        rng = np.random.default_rng(300 + i)
        A, V, t = draw(rng, (n, d)), draw(rng, (d, w)), draw(rng, (w,))
        out[f"lsh_encode_words {n}x{d}x{w}"] = digest(lsh.lsh_encode_words(A, V, t))
    torch.cuda.synchronize()
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"bits: {len(out)} outputs of {fa.__file__.rsplit('/kernels/', 1)[0]} -> {path}")


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    differ = 0
    for name in sorted(set(a) | set(b)):
        same = name in a and name in b and a[name] == b[name]
        differ += not same
        print(f"[bits] {name}: {'same bits' if same else 'DIFFER'}")
    print(json.dumps({"cases": len(set(a) | set(b)), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
