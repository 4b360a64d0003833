"""The Program IR schema of the port (``torch_framework.proto``).

The generated ``torch_framework_pb2`` needs ``google.protobuf`` and is
imported only by the desc classes' (de)serialization methods, so the
rest of the port runs where protobuf is not installed.
"""
