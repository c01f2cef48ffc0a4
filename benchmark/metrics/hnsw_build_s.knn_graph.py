"""hnsw_build_s.knn_graph: seconds of the HNSW bulk build's k-NN graph
phase (the IVF bootstrap: k-means and the grouped scan at its own
shape), ``HNSWIndex.build_seconds["knn_graph"]``."""


def read(ctx):
    return ctx.build_phases.get("knn_graph")
