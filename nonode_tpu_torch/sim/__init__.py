from .simulators import ChargedSim, GravitySim, SpringSim, SIM_REGISTRY
