"""What one kind of window drives. A configuration names its driver
(``"driver"``); the module ``drivers/<name>.py`` holds a ``Driver``
class with the interface of :class:`ltrbench.drivers.common.Driver`."""
