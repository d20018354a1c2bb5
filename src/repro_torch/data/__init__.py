from repro_torch.data.tokens import TokenStream, TokenStreamConfig, cooccurrence_matrix

__all__ = ["TokenStream", "TokenStreamConfig", "cooccurrence_matrix"]
