"""The benchmark's plain reference of GSSD++ in PyTorch (float32, TF32
off): the model, the training batch, matching, the MultiBox loss, SGD and
the scores and boxes that Detect/NMS selects from. It imports nothing of
the program under test, nor JAX."""
