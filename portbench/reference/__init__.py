"""Plain PyTorch references that decide ``correct``.  They import nothing
of the port and take nothing it made: weights and inputs come from the
harness (``core.inputs``), the program's outputs only to be judged."""
