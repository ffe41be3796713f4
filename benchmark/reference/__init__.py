"""The plain PyTorch reference that decides `correct`: a frozen copy of the
port's plain paths that imports nothing of the port (`eg3d.py`,
`avatar.py`, `ops.py`)."""
