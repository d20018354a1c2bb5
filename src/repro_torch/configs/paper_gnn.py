"""The paper's own experimental stack (§5.2/§5.3); counterpart of
``repro/configs/paper_gnn.py``.

Hyper-parameters per §C.1: decoder l=3, d_c=d_m=512, d_e=64; GraphSAGE
2 layers x 128 hidden, fanout 15; merchant system (§5.3.2): c=256, m=16,
fanout 5, 2 layers x 128.
"""

from repro_torch.configs.base import EmbeddingSpec, GNNConfig


def paper_gnn_config(model: str = "sage", n_nodes: int = 10000,
                     n_classes: int = 16, kind: str = "hash_full",
                     task: str = "node", fanout: int = 15) -> GNNConfig:
    return GNNConfig(
        name=f"paper-{model}-{kind}",
        model=model,
        n_nodes=n_nodes,
        n_classes=n_classes,
        d_e=64,
        hidden=128,
        n_gnn_layers=2,
        fanouts=(fanout, fanout),
        task=task,
        embedding=EmbeddingSpec(kind=kind, c=256, m=16, d_c=512, d_m=512, n_layers=3),
    )


def merchant_config(n_nodes: int, n_classes: int = 64,
                    kind: str = "hash_full") -> GNNConfig:
    """§5.3.2 settings: l=3, d_c=d_m=512, d_e=64, c=256, m=16, fanout 5."""
    return GNNConfig(
        name=f"merchant-sage-{kind}",
        model="sage",
        n_nodes=n_nodes,
        n_classes=n_classes,
        d_e=64,
        hidden=128,
        n_gnn_layers=2,
        fanouts=(5, 5),
        task="node",
        embedding=EmbeddingSpec(kind=kind, c=256, m=16, d_c=512, d_m=512, n_layers=3),
    )
