from repro_torch.kernels.lsh_encode.ops import (encode_dense, lsh_encode_packed,
                                                lsh_encode_word, lsh_encode_words,
                                                pack, project)
from repro_torch.kernels.lsh_encode.ref import (lsh_encode_word_ref,
                                                lsh_encode_words_ref)

__all__ = ["encode_dense", "lsh_encode_packed", "lsh_encode_word", "lsh_encode_words",
           "pack", "project", "lsh_encode_word_ref", "lsh_encode_words_ref"]
