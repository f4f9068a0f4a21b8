from tpulab_torch.harness.processors.lab1 import Lab1Processor
from tpulab_torch.harness.processors.lab2 import Lab2Processor
from tpulab_torch.harness.processors.lab3 import Lab3Processor
from tpulab_torch.harness.processors.lab5 import Lab5Processor
from tpulab_torch.harness.processors.hw import Hw1Processor, Hw2Processor

#: workload name -> processor class (the reference's MAP_LAB_PROCESSORS,
#: run_test.py:12-16, extended to the full suite)
MAP_PROCESSORS = {
    "lab1": Lab1Processor,
    "lab2": Lab2Processor,
    "lab3": Lab3Processor,
    "lab5": Lab5Processor,
    "hw1": Hw1Processor,
    "hw2": Hw2Processor,
}

__all__ = [
    "Hw1Processor",
    "Hw2Processor",
    "Lab1Processor",
    "Lab2Processor",
    "Lab3Processor",
    "Lab5Processor",
    "MAP_PROCESSORS",
]
