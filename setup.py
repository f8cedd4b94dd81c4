from setuptools import find_packages, setup

setup(
    name="dsjax",
    version="0.1.0",
    description="TPU-native DeepSpeech2 speech recognition framework (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests",)),
    package_data={"dsjax": ["configs/*.yaml", "cpp/src/*.cpp", "cpp/src/*.h"],
                  "dsjax_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "scipy",
        "pyyaml",
    ],
    extras_require={
        "metrics": ["python-Levenshtein"],
        "test": ["pytest", "torch"],
    },
)
