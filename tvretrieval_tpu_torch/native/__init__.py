"""The host's native helper, temporal NMS in C++ (the port of the JAX
package's ``native``). Importing builds nothing: the library is compiled
on first use."""
from tvretrieval_tpu_torch.native.loader import get_native_lib, native_available

__all__ = ["get_native_lib", "native_available"]
