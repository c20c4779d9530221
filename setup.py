from setuptools import find_packages, setup

setup(
    name="asvgp",
    version="0.1.0",
    description=(
        "Actually Sparse Variational Gaussian Processes in native float64 "
        "on GPU and CPU (JAX/Pallas rebuild of HJakeCunningham/ASVGP)"
    ),
    packages=find_packages(include=["asvgp", "asvgp.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy"],
)
