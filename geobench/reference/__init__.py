"""The plain reference that decides `correct`: float32 PyTorch and numpy,
written from the published description of the model and of the f* rule.
It imports nothing of the port and takes nothing the port made: it works
out again, from the inputs the benchmark hands to both sides, the crops,
the unfolded BatchNorm, the ancestor maps and, for JPEGs, the decoded
pixels. Its lower-precision form (`quant`) is the control that a sound
limit has to reject."""
