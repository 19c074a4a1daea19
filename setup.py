"""Package metadata — console script parity with the reference
(`nesr = ...cli:main`, /root/reference/setup.py:49-51)."""

from setuptools import find_packages, setup

setup(
    name="neural_enhanced_super_resolution_tpu",
    version="0.1.0",
    description=("TPU-native neural enhanced super-resolution framework "
                 "(JAX/XLA/Pallas)"),
    packages=find_packages(include=[
        "neural_enhanced_super_resolution_tpu",
        "neural_enhanced_super_resolution_tpu.*", "nesr",
        "neural_enhanced_super_resolution_torch",
        "neural_enhanced_super_resolution_torch.*", "nesr_torch"]),
    # the PyTorch port's CUDA kernel sources, built with nvcc at first use
    package_data={"neural_enhanced_super_resolution_torch": [
        "csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "numpy", "Pillow",
    ],
    extras_require={
        "convert": ["torch", "safetensors"],     # checkpoint conversion
        "hf": ["transformers", "huggingface_hub"],
        "gui": ["PyQt5"],
        "dev": ["pytest", "opencv-python"],
    },
    entry_points={
        "console_scripts": [
            "nesr = neural_enhanced_super_resolution_tpu.cli:main",
            "nesr-download = "
            "neural_enhanced_super_resolution_tpu.utils.downloader:_main",
            # the PyTorch port's CLI and model download
            "nesr-torch = neural_enhanced_super_resolution_torch.cli:main",
            "nesr-torch-download = "
            "neural_enhanced_super_resolution_torch.utils.downloader:_main",
        ],
    },
)
