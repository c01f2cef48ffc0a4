"""Value types: quantized codes, padded sparse batches, the vector graph
(``graph.VectorGraph``) and the exotic ``rtext`` / ``vectorp`` types."""
