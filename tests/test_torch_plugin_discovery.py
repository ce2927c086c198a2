"""The port's extension discovery (mythril_tpu_torch/plugin/) on the three
cases of tests/test_plugin_discovery.py, over the port's own detection
module base, module loader and laser plugin loader; and its entry-point
group, which is the port's own (`mythril_tpu_torch.plugins`), not the JAX
package's: a plugin published for the reference imports the JAX package,
which the port never loads. The CLI boots the loader before any command,
as the JAX CLI does (tests/test_torch_cli.py runs it)."""

import pytest

from mythril_tpu import plugin as jplugin
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.core.plugin.interface import LaserPlugin
from mythril_tpu_torch.core.plugin.loader import LaserPluginLoader
from mythril_tpu_torch.plugin import (MythrilLaserPlugin, MythrilPlugin,
                                      MythrilPluginLoader, PluginDiscovery,
                                      UnsupportedPluginType, discovery)


class FakeDetector(DetectionModule, MythrilPlugin):
    name = "fake-detector"
    swc_id = "000"
    description = "test detector"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["STOP"]
    taint_sinks = {"STOP": ()}
    plugin_default_enabled = True

    def _execute(self, state):
        return []


class FakeLaserPlugin(MythrilLaserPlugin):
    name = "fake-laser-plugin"
    plugin_default_enabled = True

    def __call__(self, *args, **kwargs):
        class _Plugin(LaserPlugin):
            def initialize(self, symbolic_vm):
                pass

        return _Plugin()


@pytest.fixture
def discovery_instance(monkeypatch):
    instance = PluginDiscovery()
    monkeypatch.setattr(instance, "_installed_plugins",
                        {"fake-detector": FakeDetector,
                         "fake-laser-plugin": FakeLaserPlugin})
    return instance


def test_discovery_listing(discovery_instance):
    assert discovery_instance.is_installed("fake-detector")
    assert not discovery_instance.is_installed("nope")
    assert set(discovery_instance.get_plugins()) == {"fake-detector",
                                                     "fake-laser-plugin"}
    assert set(discovery_instance.get_plugins(default_enabled=True)) == {
        "fake-detector", "fake-laser-plugin"}


def test_build_plugin(discovery_instance):
    plugin = discovery_instance.build_plugin("fake-detector")
    assert isinstance(plugin, FakeDetector)
    with pytest.raises(ValueError):
        discovery_instance.build_plugin("missing")


def test_loader_dispatch(discovery_instance):
    loader = MythrilPluginLoader()
    detector = discovery_instance.build_plugin("fake-detector")
    loader.load(detector)
    registered = [type(m).__name__
                  for m in ModuleLoader().get_detection_modules()]
    assert "FakeDetector" in registered
    # laser plugins land in the engine plugin loader as builders
    laser = discovery_instance.build_plugin("fake-laser-plugin")
    loader.load(laser)
    assert "fake-laser-plugin" in LaserPluginLoader().laser_plugin_builders

    class Unknown(MythrilPlugin):
        pass

    with pytest.raises(UnsupportedPluginType):
        loader.load(Unknown())

    # cleanup: drop the fake detector so later tests see the stock 18
    ModuleLoader()._modules = [
        m for m in ModuleLoader()._modules
        if type(m).__name__ != "FakeDetector"]
    LaserPluginLoader().laser_plugin_builders.pop("fake-laser-plugin", None)
    loader.loaded_plugins = [plugin for plugin in loader.loaded_plugins
                             if plugin not in (detector, laser)]


def test_entry_point_group_is_the_ports_own():
    """The port discovers `mythril_tpu_torch.plugins`, beside the JAX
    package's `mythril_tpu.plugins`, and its plugin classes are its own."""
    assert discovery.ENTRY_POINT_GROUP == "mythril_tpu_torch.plugins"
    assert jplugin.discovery.ENTRY_POINT_GROUP == "mythril_tpu.plugins"
    assert not issubclass(MythrilPlugin, jplugin.MythrilPlugin)
    assert not issubclass(jplugin.MythrilPlugin, MythrilPlugin)
