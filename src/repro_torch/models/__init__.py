"""Dense model family: layers, paged attention, the Model module."""
