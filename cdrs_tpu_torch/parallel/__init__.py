"""The device mesh (``mesh.py``) and its multi-process tier over
``torch.distributed`` (``distributed.py``)."""
