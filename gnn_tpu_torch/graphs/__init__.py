"""Host graphs, datasets and padded tensor batches."""
