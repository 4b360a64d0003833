"""Framework-neutral helpers of the port (counterpart of
``paddle_tpu/utils``; the tensor file format so far)."""
