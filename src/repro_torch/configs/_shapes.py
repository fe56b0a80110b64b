"""Shape tables of the four families (copies of
``repro/configs/_shapes.py``'s ``LM_SHAPES``, ``GNN_SHAPES``,
``RECSYS_SHAPES`` and ``ENGINE_SHAPES``)."""
from ..config import ShapeSpec

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          (("seq_len", 4096), ("global_batch", 256))),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             (("seq_len", 32768), ("global_batch", 32))),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            (("seq_len", 32768), ("global_batch", 128))),
    "long_500k": ShapeSpec("long_500k", "decode",
                           (("seq_len", 524288), ("global_batch", 1))),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "gnn_full",
                               (("n_nodes", 2708), ("n_edges", 10556),
                                ("d_feat", 1433))),
    "minibatch_lg": ShapeSpec("minibatch_lg", "gnn_mini",
                              (("n_nodes", 232965), ("n_edges", 114615892),
                               ("batch_nodes", 1024), ("fanout", (15, 10)),
                               ("d_feat", 602))),
    "ogb_products": ShapeSpec("ogb_products", "gnn_full",
                              (("n_nodes", 2449029), ("n_edges", 61859140),
                               ("d_feat", 100))),
    "molecule": ShapeSpec("molecule", "gnn_mol",
                          (("n_nodes", 30), ("n_edges", 64), ("batch", 128))),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "recsys_train", (("batch", 65536),)),
    "serve_p99": ShapeSpec("serve_p99", "recsys_serve", (("batch", 512),)),
    "serve_bulk": ShapeSpec("serve_bulk", "recsys_serve", (("batch", 262144),)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "recsys_retrieval",
                                (("batch", 1), ("n_candidates", 1_000_000),)),
}

ENGINE_SHAPES = {
    "batch_1b": ShapeSpec("batch_1b", "engine_batch",
                          (("n_vertices", 67_108_864), ("avg_degree", 16),
                           ("n_queries", 512), ("k", 6))),
}
