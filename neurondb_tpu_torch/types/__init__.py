"""Vector formats: quantized codes and padded sparse batches."""
