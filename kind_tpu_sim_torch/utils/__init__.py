"""Runtime helpers of the PyTorch port."""
