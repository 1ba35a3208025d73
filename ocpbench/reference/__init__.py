"""Plain PyTorch references that decide ``correct``.  They import nothing
of the program: a configuration's ``reference`` key names its module."""
