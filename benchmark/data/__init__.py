"""Generators of the configurations' stand-in data, one module each, named
by a configuration's `generator`."""
