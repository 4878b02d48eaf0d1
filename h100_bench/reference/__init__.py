"""Plain PyTorch references of the benchmark's models, independent of the
program under test: the same equations written out with ordinary ``torch``
operations, float32 with TF32 off, and no kernel, cache or batching trick.
A model's module is found by the ``model`` key of its configuration file
(``reference/<model>.py``); ``common`` holds what the models share."""
