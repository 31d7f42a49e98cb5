"""repro_torch.roofline: the roofline counted on the port's own steps."""
