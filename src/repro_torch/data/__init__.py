"""Data of the port: the paper's synthetic linear regression."""

from repro_torch.data.synthetic import (
    SyntheticLinReg,
    distance_to_opt,
    linreg_loss,
    make_synthetic_linreg,
)

__all__ = ["SyntheticLinReg", "make_synthetic_linreg", "linreg_loss", "distance_to_opt"]
