"""Small shared utilities: JAX's threefry key tree (``utils/prng.py``,
``utils/keys.py``), the statistical bound for a solve of one random
stream against another (``utils/stats.py``) and episode
plotting (``utils/plotting.py``, matplotlib imported when drawing)."""

from covo_mpc_tpu_torch.utils.keys import fold_in_batch

__all__ = ["fold_in_batch"]
