"""Host-side data: the DeepFashion datasets and loaders, their transforms and
segmenters, the readiness drill and a writer of DeepFashion-shaped trees."""
