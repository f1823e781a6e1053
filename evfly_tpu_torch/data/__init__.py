"""Training data: the trajectory dataloader (numpy) and chunk augmentation."""
