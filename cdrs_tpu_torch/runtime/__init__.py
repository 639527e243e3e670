"""Host runtime: the native host library's ctypes bindings (``native.py``)."""
