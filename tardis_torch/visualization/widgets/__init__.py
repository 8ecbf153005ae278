from tardis_torch.visualization.widgets.shell_info import (  # noqa: F401
    BaseShellInfo,
    HDFShellInfo,
    ShellInfoWidget,
    SimulationShellInfo,
    shell_info_from_hdf,
    shell_info_from_simulation,
)
from tardis_torch.visualization.widgets.line_info import (  # noqa: F401
    LineInfoWidget,
)
