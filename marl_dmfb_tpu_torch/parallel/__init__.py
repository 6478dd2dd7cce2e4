"""Several trainings as one program: the seed farm (``seedfarm.py``)."""
