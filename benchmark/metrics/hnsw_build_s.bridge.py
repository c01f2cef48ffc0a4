"""hnsw_build_s.bridge: seconds of the HNSW bulk build's component
bridging phase, ``HNSWIndex.build_seconds["bridge"]``."""


def read(ctx):
    return ctx.build_phases.get("bridge")
