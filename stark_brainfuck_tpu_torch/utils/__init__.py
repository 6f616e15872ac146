"""utils layer of the torch port (see the package docstring)."""
