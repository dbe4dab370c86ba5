"""Global numeric configuration of the PyTorch port.

Counterpart of ``cedarsim_tpu/config.py``, dtype half only: circuit state,
model evaluation and the exact solves are float64 (conductances span ~15
decades).  The port never calls ``torch.set_default_dtype``; every tensor it
makes names its dtype.  The JAX package's XLA-cache settings have no
counterpart here (PyTorch runs eagerly).
"""

import torch

#: dtype of simulator state, model evaluation and exact solves
real_dtype = torch.float64

#: Boltzmann constant (J/K)
K_BOLTZMANN = 1.380649e-23
#: elementary charge (C)
Q_CHARGE = 1.602176634e-19
#: 0 Celsius in Kelvin
T_ZERO_C = 273.15
