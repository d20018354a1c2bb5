from repro_torch.kernels.lsh_encode.ops import (lsh_encode_packed,
                                                lsh_encode_word)
from repro_torch.kernels.lsh_encode.ref import lsh_encode_word_ref

__all__ = ["lsh_encode_packed", "lsh_encode_word", "lsh_encode_word_ref"]
