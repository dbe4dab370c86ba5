from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.devices.simple import (
    Resistor, Capacitor, VSource, VSourcePWL, VSourcePULSE,
)
