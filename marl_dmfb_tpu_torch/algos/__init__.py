"""Learners of the PyTorch port."""
