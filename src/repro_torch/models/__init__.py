"""Models of the port (GNNs so far), as plain functions on tensors."""
