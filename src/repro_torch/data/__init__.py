"""Data of the port: the paper's synthetic linear regression, the generated
image set, the label-Dirichlet partitioner and per-client Markov token
streams for LM training."""

from repro_torch.data.dirichlet import client_image_batches, dirichlet_partition
from repro_torch.data.images import ImageDataset, make_image_dataset
from repro_torch.data.synthetic import (
    SyntheticLinReg,
    distance_to_opt,
    linreg_loss,
    make_synthetic_linreg,
)
from repro_torch.data.tokens import MarkovStream, make_client_stream

__all__ = ["SyntheticLinReg", "make_synthetic_linreg", "linreg_loss", "distance_to_opt",
           "ImageDataset", "make_image_dataset", "dirichlet_partition", "client_image_batches",
           "MarkovStream", "make_client_stream"]
