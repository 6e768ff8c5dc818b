"""ISP models of the PyTorch port."""
