"""Rule modules. Importing this package registers every rule with
`wam_tpu_torch.lint.registry` (each module's classes carry ``@register``)."""

from wam_tpu_torch.lint.rules import donation as _donation  # noqa: F401
from wam_tpu_torch.lint.rules import host_sync as _host_sync  # noqa: F401
from wam_tpu_torch.lint.rules import locks as _locks  # noqa: F401
from wam_tpu_torch.lint.rules import precision as _precision  # noqa: F401
from wam_tpu_torch.lint.rules import retrace as _retrace  # noqa: F401
