"""Fork choice: the proto-array node store and the LMD vote columns."""

from lighthouse_tpu_torch.fork_choice.fork_choice import ForkChoice, ForkChoiceError
from lighthouse_tpu_torch.fork_choice.proto_array import ProtoArray

__all__ = ["ForkChoice", "ForkChoiceError", "ProtoArray"]
