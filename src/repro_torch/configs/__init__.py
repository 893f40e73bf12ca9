"""Model and run configurations: a copy of the JAX package's pure-data configs."""
