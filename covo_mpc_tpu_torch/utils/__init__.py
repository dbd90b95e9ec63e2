"""Small shared utilities: episode plotting (``utils/plotting.py``)."""
