"""``synthetic_mnist``: class-structured 28x28 digits from the run's seed
(``harness/data.py synthetic_mnist``; the real MNIST files are not in the
repository).  ``sizes``: the train, validation and test counts."""

from harness import data


def make(spec: dict, sizes: tuple, seed: int) -> dict:
    d = data.synthetic_mnist(*sizes, seed=seed)
    return {key: (d[f"{key}_data"], d[f"{key}_labels"])
            for key in ("train", "val", "test")}
