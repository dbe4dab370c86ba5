from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.devices.simple import (
    Resistor, Capacitor, Inductor, CoupledInductors,
    VSource, VSourcePWL, VSourcePULSE, VSourceSIN, VSourceEXP,
    ISource, ISourcePWL, ISourcePULSE, ISourceSIN, ISourceEXP,
    VCVS, VCCS, CCVS, CCCS, VSwitch, ISwitch, Diode,
    OpenCircuit, ShortCircuit, TLine, LTRALine, nonlinear_resistor,
    nonlinear_capacitor,
)
from cedarsim_tpu_torch.devices.mos import Mos1
from cedarsim_tpu_torch.devices.bjt import Bjt
from cedarsim_tpu_torch.devices.jfet import Jfet, Mesfet
