"""Headless interactive video-object segmentation sessions.

Counterpart of ``d3fields_tpu/interact/``. The reference ships a Qt GUI
(``XMem/inference/interact/gui.py``) whose function, marking an object
mask on any frame by clicks, scribbles or free painting, committing it,
propagating it with XMem both ways and saving paletted masks, lives here
without the widgets: the event loop becomes a method-call API
(:class:`InteractiveSession`) and a scriptable CLI (``apps/interactive.py``).
"""

from d3fields_tpu_torch.interact.overlays import (  # noqa: F401
    get_visualization,
    get_visualization_soft,
)
from d3fields_tpu_torch.interact.session import (  # noqa: F401
    ClickInteraction,
    FreeInteraction,
    InteractiveSession,
    ScribbleInteraction,
    aggregate_wbg,
)
