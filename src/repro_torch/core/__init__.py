"""Scheduler and packed forward step of the PyTorch port."""
