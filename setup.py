from setuptools import find_packages, setup

setup(
    name="ngspeciesid-tpu",
    version="0.1.0",
    description="TPU-native amplicon species-ID engine (clustering + consensus + polishing)",
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={"ngspeciesid_tpu": ["data/*.npz"],
                  "ngspeciesid_tpu_torch": ["data/*.npz", "native/*.cpp",
                                            "csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "NGSpeciesID-tpu=ngspeciesid_tpu.cli:main_and_exit",
            "NGSpeciesID-torch=ngspeciesid_tpu_torch.cli:main_and_exit",
        ]
    },
)
