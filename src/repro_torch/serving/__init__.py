"""Serving engine, requests and service metrics of the PyTorch port."""
