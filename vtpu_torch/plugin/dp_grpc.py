"""Hand-written gRPC service wiring for the kubelet device-plugin API
(the port's copy of vtpu/plugin/dp_grpc.py).

grpcio is available but grpcio-tools is not, so the service scaffolding that
`protoc-gen-grpc_python` would emit is written by hand against the generated
message module (deviceplugin_pb2). The wire format is identical.
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb

DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"
REGISTRATION_SERVICE = "v1beta1.Registration"
API_VERSION = "v1beta1"
KUBELET_SOCKET = "kubelet.sock"


class DevicePluginServicer:
    """Override the five RPCs (reference: plugin/server.go:236-403)."""

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions()

    def ListAndWatch(self, request, context):
        raise NotImplementedError

    def GetPreferredAllocation(self, request, context):
        return pb.PreferredAllocationResponse()

    def Allocate(self, request, context):
        raise NotImplementedError

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()


def add_device_plugin_servicer(server: grpc.Server,
                               servicer: DevicePluginServicer) -> None:
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=(
                pb.PreferredAllocationResponse.SerializeToString
            ),
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(DEVICE_PLUGIN_SERVICE,
                                              handlers),)
    )


class DevicePluginStub:
    """Client stub (used by tests acting as a fake kubelet)."""

    def __init__(self, channel: grpc.Channel) -> None:
        p = f"/{DEVICE_PLUGIN_SERVICE}/"
        self.GetDevicePluginOptions = channel.unary_unary(
            p + "GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            p + "ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            p + "GetPreferredAllocation",
            request_serializer=(
                pb.PreferredAllocationRequest.SerializeToString
            ),
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            p + "Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            p + "PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


class RegistrationServicer:
    """Server side of Registration — implemented by the *fake kubelet* in
    tests; real kubelet implements it in production."""

    def Register(self, request, context):
        return pb.Empty()


def add_registration_servicer(server: grpc.Server,
                              servicer: RegistrationServicer) -> None:
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(REGISTRATION_SERVICE,
                                              handlers),)
    )


class RegistrationStub:
    """Client used by the plugin to register itself with kubelet
    (reference: plugin/server.go:205-234)."""

    def __init__(self, channel: grpc.Channel) -> None:
        self.Register = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )
