from setuptools import find_packages, setup

setup(
    name="covo_mpc_tpu",
    version="0.1.0",
    description=(
        "TPU-native sampling-based MPC framework: MPPI and CoVO-MPC with "
        "fused Pallas rollout kernels and multi-chip sharding via shard_map."
    ),
    packages=find_packages(include=["covo_mpc_tpu", "covo_mpc_tpu.*",
                                    "covo_mpc_tpu_torch", "covo_mpc_tpu_torch.*"]),
    # the PyTorch port's CUDA sources, compiled by nvcc at first use
    package_data={"covo_mpc_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "chex",
        "numpy",
    ],
    extras_require={
        "viz": ["matplotlib"],
        "test": ["pytest"],
    },
)
