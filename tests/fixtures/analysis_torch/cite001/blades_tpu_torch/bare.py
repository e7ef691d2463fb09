x = 1  # VIOLATION: no module docstring / citation
