"""Training: float network, losses, data generation, and the train loop.

The counterpart of ``nnnoiseless_tpu/training/``: the reference training
path (src/training.rs + train/rnn_train.py + train/dump_rnn.py) in
PyTorch, with the same topology, losses, 87-column HDF5 feature schema and
int8 quantizer, so trained models load back into the inference engine (and
into the reference).  Every matmul runs in full float32: importing the
package runs ``denoise``, which turns TF32 off.
"""

from .network import TrainableModel, init_train_params, sequence_forward  # noqa: F401
from .losses import gain_loss, total_loss, vad_loss  # noqa: F401
