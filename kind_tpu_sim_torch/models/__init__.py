"""The model path: transformer, decode, continuous batching, paging."""
