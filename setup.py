from setuptools import find_packages, setup

setup(
    name="triangle_splatting_tpu",
    version="0.1.0",
    packages=find_packages(include=["triangle_splatting_tpu",
                                    "triangle_splatting_tpu.*",
                                    "triangle_splatting_tpu_torch",
                                    "triangle_splatting_tpu_torch.*"]),
    package_data={"triangle_splatting_tpu_torch.ops.cuda": ["csrc/*.cu"]},
    install_requires=[
        "jax",
        "numpy",
        "pyyaml",
        "scipy",
        "pillow",
    ],
    extras_require={
        "viz": ["opencv-python", "matplotlib", "tensorboard"],
        # the PyTorch/CUDA port (triangle_splatting_tpu_torch)
        "torch": ["torch"],
    },
    description="TPU-native 2D Triangle Splatting (2DTS) framework",
    python_requires=">=3.10",
)
