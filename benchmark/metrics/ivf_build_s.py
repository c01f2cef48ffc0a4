"""ivf_build_s: wall seconds of the IVFFlat build (k-means, assignment,
packing and the uploads), from the host corpus handed to
``IVFFlatIndex`` to a searchable index, ended by a device sync."""


def read(ctx):
    return ctx.build_s
