"""fhe_fed_tpu — secure federated aggregation (CKKS FedAvg) in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of the
fhe-fed reference (FHE-based FedAvg over PALISADE-CKKS): uint32 RNS limbs,
Shoup-multiplied NTTs, whole-model batched encrypt/aggregate/decrypt, and
mesh-sharded aggregation.
"""

from .fed.api import CKKS
from .fed.threshold_api import ThresholdCKKS
from .fed.scheme import Scheme, get_scheme, register_scheme
from .fed.fedavg import (fhe_fedavg, plain_fedavg, flatten_params,
                         unflatten_params, SelectivePolicy)
from .fed.masking import Masking
from .ckks.params import make_params, make_context, CkksParams, CkksContext
from .ckks import keys, ops, serial, encoding, keyswitch, slots

__version__ = "0.1.0"

__all__ = [
    "CKKS", "ThresholdCKKS", "Masking", "Scheme", "get_scheme", "register_scheme",
    "fhe_fedavg", "plain_fedavg", "flatten_params", "unflatten_params",
    "SelectivePolicy",
    "make_params", "make_context", "CkksParams", "CkksContext",
    "keys", "ops", "serial", "encoding", "keyswitch", "slots",
]
