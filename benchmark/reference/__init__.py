"""Plain PyTorch references of the solvers, one module each, named as the
method they judge. They import nothing of the program."""
