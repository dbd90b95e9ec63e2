"""Small shared utilities: JAX's threefry key tree (``utils/prng.py``,
``utils/keys.py``) and episode plotting (``utils/plotting.py``)."""
