"""The port's model code: layers, attention, stack assembly, Model API."""
