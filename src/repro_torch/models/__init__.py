"""Dense decoder layers, attention, assembly and the model registry."""
