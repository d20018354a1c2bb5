from repro_torch.kernels.hash_decode.ops import (code_order, dequantize_codebooks,
                                                 hash_decode,
                                                 hash_decode_backward,
                                                 quantize_codebooks)
from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref, hash_decode_ref

__all__ = ["hash_decode", "hash_decode_backward", "code_order", "hash_decode_ref",
           "hash_decode_backward_ref", "quantize_codebooks", "dequantize_codebooks"]
